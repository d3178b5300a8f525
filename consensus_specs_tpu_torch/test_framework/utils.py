"""pytest ↔ generator dual-mode adapter (ref: test/utils/utils.py)."""
from __future__ import annotations

from consensus_specs_tpu_torch.ssz.types import SSZType

from .meta import copy_meta


def vector_test():
    """Wrap a yielding test so that:
    - generator mode returns [(name, kind, value), ...] parts with kinds
      inferred (SSZ view → "ssz", bytes → "ssz", else "data"; explicit
      3-tuples pass through) — ref utils.py:29-55;
    - pytest mode drains and discards the generator — ref utils.py:63-69.
    """

    def runner(fn):
        def entry(*args, **kw):
            # Parts must be captured AT YIELD TIME: helpers yield the live
            # state ("pre") and then mutate it in place, so a raw reference
            # written after the case finishes would reflect the post state.
            # SSZ values are frozen by serializing on yield and None-valued
            # parts are dropped, both exactly as the reference adapter does
            # (utils.py:29-55).
            def snapshot(kind, value):
                if kind == "ssz" and isinstance(value, SSZType):
                    return value.encode_bytes()
                if kind == "data" and isinstance(value, SSZType):
                    return value.copy()
                if isinstance(value, bytearray):
                    return bytes(value)
                return value

            def generator_mode():
                out = fn(*args, **kw)
                if out is None:
                    return
                for part in out:
                    if len(part) == 2:
                        (key, value) = part
                        if value is None:
                            continue
                        if isinstance(value, (SSZType, bytes, bytearray)):
                            yield key, "ssz", snapshot("ssz", value)
                        elif (
                            isinstance(value, (list, tuple))
                            and value
                            and all(isinstance(v, SSZType) for v in value)
                        ):
                            # an SSZ *list part* (e.g. "blocks") expands to
                            # the reference vector shape: a {key}_count meta
                            # entry plus one {key}_<i>.ssz_snappy per element
                            # (ref utils.py list handling; formats/sanity)
                            yield f"{key}_count", "meta", len(value)
                            for i, item in enumerate(value):
                                yield f"{key}_{i}", "ssz", snapshot("ssz", item)
                        else:
                            yield key, "data", snapshot("data", value)
                    else:
                        (key, kind, value) = part
                        if value is None and kind != "meta":
                            continue
                        yield key, kind, snapshot(kind, value)

            if kw.pop("generator_mode", False):
                return list(generator_mode())
            # pytest mode: drain; designed skips become pytest skips
            from consensus_specs_tpu_torch.exceptions import SkippedTest

            try:
                out = fn(*args, **kw)
                if out is not None:
                    for _ in out:
                        continue
            except SkippedTest as e:
                import pytest

                pytest.skip(str(e))
            return None

        return copy_meta(entry, fn)

    return runner


def with_meta_tags(tags: dict):
    """Append meta key/values to the test's output parts (ref utils.py:76)."""

    def runner(fn):
        def entry(*args, **kw):
            yielded_any = False
            out = fn(*args, **kw)
            if out is not None:
                for part in out:
                    yielded_any = True
                    yield part
            if yielded_any:
                for k, v in tags.items():
                    yield k, "meta", v

        return copy_meta(entry, fn)

    return runner
