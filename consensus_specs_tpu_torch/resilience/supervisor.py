"""Supervised execution: retry transient faults with backoff, re-raise
everything else.

The generator runs its cases, and the writer thread its commits, under
``supervised()``: a transient fault (an ``OSError`` of the writer, say) is
retried with backoff, anything else is re-raised and the case counted
failed. There is no fallback. Every retry and give-up lands in a bounded
in-process event log (``events()``), so a run can show that nothing was
retried.

Pure stdlib.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, List, Optional

from . import taxonomy
from .taxonomy import ENVIRONMENTAL, TRANSIENT


@dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff under a deadline, for TRANSIENT faults only."""

    max_attempts: int = 3          # total tries (1 initial + retries)
    base_delay_s: float = 0.05
    factor: float = 2.0
    max_delay_s: float = 2.0
    deadline_s: Optional[float] = None  # wall-clock cap across all tries

    def delay(self, retry_index: int) -> float:
        return min(self.base_delay_s * (self.factor ** retry_index), self.max_delay_s)


DEFAULT_POLICY = RetryPolicy()

# ---------------------------------------------------------------------------
# event log
# ---------------------------------------------------------------------------

_EVENTS: deque = deque(maxlen=512)


def record_event(event: str, *, domain: str = "", kind: str = "", detail: str = "") -> dict:
    entry = {
        "t": round(time.time(), 3),
        "event": event,
        "domain": domain,
        "kind": kind,
        "detail": detail[:500],
    }
    _EVENTS.append(entry)
    return entry


def events(clear: bool = False) -> List[dict]:
    out = list(_EVENTS)
    if clear:
        _EVENTS.clear()
    return out


# ---------------------------------------------------------------------------
# supervised execution
# ---------------------------------------------------------------------------

def supervised(fn: Callable, *, domain: str,
               policy: RetryPolicy = DEFAULT_POLICY,
               classify: Callable[[BaseException], str] = taxonomy.classify,
               passthrough: tuple = (),
               sleep: Callable[[float], None] = time.sleep):
    """Run ``fn()`` under the retry policy.

    - TRANSIENT faults retry with exponential backoff up to
      ``policy.max_attempts`` tries within ``policy.deadline_s``.
    - DETERMINISTIC / ENVIRONMENTAL faults, and exhausted transients (a
      fault that never stops being "transient" is an environment
      problem), are recorded as ``gave_up`` and re-raised.
    - ``passthrough`` exception types re-raise untouched (control-flow
      exceptions like SkippedTest are not faults).
    """
    t0 = time.monotonic()
    retries = 0
    while True:
        try:
            return fn()
        except BaseException as exc:
            if isinstance(exc, (KeyboardInterrupt, SystemExit)) or (
                    passthrough and isinstance(exc, passthrough)):
                raise
            kind = classify(exc)
            detail = f"{type(exc).__name__}: {exc}"
            if kind == TRANSIENT:
                within_deadline = (policy.deadline_s is None
                                   or time.monotonic() - t0 < policy.deadline_s)
                if retries + 1 < policy.max_attempts and within_deadline:
                    record_event("retry", domain=domain, kind=kind, detail=detail)
                    sleep(policy.delay(retries))
                    retries += 1
                    continue
                kind = ENVIRONMENTAL  # transients that never clear
                detail = f"retries exhausted ({retries + 1} tries): {detail}"
            record_event("gave_up", domain=domain, kind=kind, detail=detail)
            raise
