"""Flush planner: power-of-two key buckets for the deferred BLS flush (the
port's copy of the JAX package's ``sched/bucketing.py``, as far as the
port uses it).

A flush records signature checks whose aggregate widths (pubkeys per
check) span 1..512. The planner groups rows by the power-of-two bucket of
their width (floored at the backend's key minimum) and chunks each group
under the backend's row cap; each chunk is one device call. Nothing in the
port recompiles per shape and the device pipeline pads no rows, so the
JAX planner's row padding and its waste accounting are not carried over.
The backend's ``cold_shape_floors`` sets the floor and the cap; they
decide how many device calls a flush makes.
"""
from __future__ import annotations

from typing import Dict, List, Sequence


def pow2_bucket(n: int, minimum: int = 1) -> int:
    """Smallest power-of-two >= max(n, minimum) (minimum itself need not
    be a power of two; the result is then the next pow2 above it)."""
    b = 1
    floor = max(1, minimum)
    while b < floor or b < n:
        b <<= 1
    return b


def plan_flush(widths: Sequence[int], *, max_rows: int, min_keys: int) -> List[List[int]]:
    """The device calls for deduped rows of the given aggregate ``widths``
    (pubkeys per check), as lists of row indices: rows land in their
    width's power-of-two key bucket, and each bucket is chunked to at most
    ``max_rows`` rows a call. Order is kept within a bucket, so results
    map back by index."""
    by_k: Dict[int, List[int]] = {}
    for i, w in enumerate(widths):
        by_k.setdefault(pow2_bucket(w, minimum=min_keys), []).append(i)
    return [rows[start : start + max_rows]
            for _, rows in sorted(by_k.items())
            for start in range(0, len(rows), max_rows)]
