"""Structured fault taxonomy.

Every failure falls into one of three classes, and the class — not the
exception type — decides the recovery action:

- TRANSIENT: the operation may succeed if simply tried again (resource
  exhaustion, an I/O flake, a subprocess timeout). Recovery: retry with
  exponential backoff under a deadline.
- DETERMINISTIC: retrying is pointless — the same inputs will fail the
  same way (a wrong result caught by a check, a compile error). Recovery:
  none; the fault is re-raised and the case counted failed.
- ENVIRONMENTAL: a prerequisite is absent (a module not importable, a
  library or binary missing, no device). Recovery: as deterministic, but
  the event is recorded as an environment gap, not a defect.

Pure stdlib.
"""
from __future__ import annotations

from typing import Optional

TRANSIENT = "transient"
DETERMINISTIC = "deterministic"
ENVIRONMENTAL = "environmental"

KINDS = (TRANSIENT, DETERMINISTIC, ENVIRONMENTAL)


class Fault(Exception):
    """A failure that already carries its classification (raised by
    injection hooks and by code that knows its own failure mode)."""

    kind: str = DETERMINISTIC

    def __init__(self, message: str = "", *, domain: str = ""):
        super().__init__(message)
        self.domain = domain


class TransientFault(Fault):
    kind = TRANSIENT


class DeterministicFault(Fault):
    kind = DETERMINISTIC


class EnvironmentalFault(Fault):
    kind = ENVIRONMENTAL


# Message substrings that mark a runtime error as retryable even though
# its Python type is opaque: resource pressure (a CUDA allocator's "out of
# memory" among them), dead connections, deadline hits.
_TRANSIENT_MARKERS = (
    "RESOURCE_EXHAUSTED",
    "out of memory",
    "OOM",
    "DEADLINE_EXCEEDED",
    "UNAVAILABLE",
    "ABORTED",
    "remote_compile",
    "response body closed",
    "Connection reset",
    "Socket closed",
    "timed out",
)


def classify(exc: BaseException) -> str:
    """Map an exception to its fault class. Explicit Fault subclasses
    win; everything else is classified structurally, with DETERMINISTIC
    as the safe default (an unknown failure must be reported, never spin
    in a retry loop)."""
    if isinstance(exc, Fault):
        return exc.kind
    if isinstance(exc, (ImportError, ModuleNotFoundError)):
        return ENVIRONMENTAL
    if isinstance(exc, (TimeoutError, ConnectionError, BrokenPipeError,
                        InterruptedError, MemoryError)):
        return TRANSIENT
    try:  # subprocess is stdlib but keep the import local: hot paths
        import subprocess

        if isinstance(exc, subprocess.TimeoutExpired):
            return TRANSIENT
    except Exception:  # pragma: no cover
        pass
    if isinstance(exc, FileNotFoundError):
        return ENVIRONMENTAL  # missing lib/binary, not a data error
    if isinstance(exc, OSError):
        return TRANSIENT  # I/O flake: fd churn, EAGAIN-class errors
    text = f"{type(exc).__name__}: {exc}"
    if any(marker in text for marker in _TRANSIENT_MARKERS):
        return TRANSIENT
    return DETERMINISTIC
