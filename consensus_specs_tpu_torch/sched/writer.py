"""Overlapped case serialization: a bounded, supervised writer thread.

The generator's committed cases are written (yaml and snappy-framed part
files, then the fsync'd journal append) on this thread, so that the
serialization overlaps the next case's compute and the next flush:

- **bounded**: a full queue blocks ``submit`` (backpressure — memory
  stays bounded by ``maxsize`` encoded cases; ``backpressure_waits``
  counts the waits);
- **ordered**: one worker thread drains FIFO, so journal-append order
  equals submit order — a kill loses at most the queued tail, whose case
  dirs are absent or INCOMPLETE-marked and therefore regenerate on
  resume; everything the journal admitted was fully written and fsync'd
  before its entry;
- **supervised**: each write runs under the resilience supervisor
  (transient faults — EIO-class flakes — retry with backoff, recorded in
  its event log); terminal failures are captured per case and surfaced
  to the caller at ``close()`` instead of dying silently on a daemon
  thread.

Pure stdlib (threading + queue).
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Callable, List, Optional, Tuple

from ..resilience import RetryPolicy, record_event, supervised

# transient-write budget: disk flakes clear fast or not at all
WRITE_RETRY_POLICY = RetryPolicy(max_attempts=3, base_delay_s=0.02, max_delay_s=0.5)

DEFAULT_QUEUE_SIZE = 64

_STOP = object()


class CaseWriter:
    """Background committer: ``submit()`` enqueues one committed case's
    write closure arguments; the worker runs ``commit_fn(*args)`` in
    submit order. ``close()`` drains, joins, and returns the failures
    as ``(label, error_repr)`` pairs."""

    def __init__(self, commit_fn: Callable[..., None], *,
                 maxsize: int = DEFAULT_QUEUE_SIZE) -> None:
        self._commit_fn = commit_fn
        self._q: "queue.Queue[Any]" = queue.Queue(maxsize=max(1, maxsize))
        self.failures: List[Tuple[str, str]] = []
        self.written = 0
        self.submitted = 0
        self.backpressure_waits = 0
        self._thread: Optional[threading.Thread] = None
        self._closed = False

    def _ensure_thread(self) -> None:
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, name="sched-case-writer", daemon=True)
            self._thread.start()

    def submit(self, label: str, *args: Any) -> None:
        """Enqueue one case write. Blocks when the queue is full (the
        backpressure bound)."""
        assert not self._closed, "submit() after close()"
        self._ensure_thread()
        self.submitted += 1
        if self._q.full():
            self.backpressure_waits += 1
        self._q.put((label, args))

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is _STOP:
                self._q.task_done()
                return
            label, args = item
            try:
                self._write_one(label, args)
            finally:
                self._q.task_done()

    def _write_one(self, label: str, args: Tuple[Any, ...]) -> None:
        try:
            supervised(lambda: self._commit_fn(*args), domain="sched.writer",
                       policy=WRITE_RETRY_POLICY)
            self.written += 1
        except Exception as e:  # terminal: surfaced at close()
            self.failures.append((label, repr(e)))
            record_event("writer_failed", domain="sched.writer", detail=f"{label}: {e!r}")

    def close(self) -> List[Tuple[str, str]]:
        """Drain, stop the worker, and return the per-case failures."""
        if not self._closed:
            self._closed = True
            if self._thread is not None:
                self._q.put(_STOP)
                self._q.join()
                self._thread.join(timeout=60)
        return list(self.failures)
