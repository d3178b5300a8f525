"""Resilience for the vector generator: the fault taxonomy, supervised
execution with its event log, and the crash-safe digest journal.

- :mod:`taxonomy` — transient / deterministic / environmental fault
  classes and the classifier of exceptions.
- :mod:`supervisor` — ``supervised()`` retry-with-backoff for
  transients, and the bounded event log (``events()``) where every retry
  and give-up is recorded.
- :mod:`journal` — the crash-safe digest journal of ``run_generator``:
  resumed runs re-admit only byte-verified cases and regenerate
  corrupted output instead of shipping it.

Pure stdlib.
"""
from __future__ import annotations

from .journal import CaseJournal, encode_entry, verify_outputs  # noqa: F401
from .supervisor import RetryPolicy, events, record_event, supervised  # noqa: F401
from .taxonomy import DETERMINISTIC, ENVIRONMENTAL, TRANSIENT, Fault, TransientFault, classify  # noqa: F401
