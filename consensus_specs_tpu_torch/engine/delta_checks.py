"""Check inputs for K10 ``flag_deltas`` and their value in Python integers,
for the tests and ``chip_smoke.py``; nothing on the main path imports it."""
from __future__ import annotations

import numpy as np

# (brpi, weight, upi, active_increments, wd): a 2^19-validator registry's
# scalars at 95% participation (target weight), the same with upi 0 (head
# weight), and a reward numerator just below 2^63 (the plain version's
# range: increments of 32)
SCALARS = [
    (1_397, 26, 15_938_355, 16_777_216, 64),
    (1_397, 14, 0, 16_777_216, 64),
    (2**36, 14, 2**63 // (32 * 2**36 * 14), 2**40, 64),
]
# a reward numerator between 2^63 and 2^64 - 1 at increments of 32: past
# the plain version's range, inside K10's
SCALARS_PAST_INT64 = (2**40, 26, 20_000, 2**41, 64)
# (increments, in_mask, eligible) rows: increments 0 and 32 under every mask pair
EDGES = [(inc, m, e) for inc in (0, 32) for m in (False, True) for e in (False, True)]


def columns(n: int, seed: int) -> tuple:
    """n seeded rows (increments 0..32, ~90% in the flag, ~97% eligible),
    the edge rows last where n has room for them twice over."""
    rng = np.random.default_rng([seed, n])
    edges = EDGES if n >= 2 * len(EDGES) else []
    k = n - len(edges)
    increments = np.concatenate([rng.integers(0, 33, k), [r[0] for r in edges]]).astype(np.uint64)
    in_mask = np.concatenate([rng.random(k) < 0.9, np.array([r[1] for r in edges], dtype=bool)])
    eligible = np.concatenate([rng.random(k) < 0.97, np.array([r[2] for r in edges], dtype=bool)])
    return increments, in_mask, eligible


def python_deltas(increments, in_mask, eligible, brpi: int, weight: int, upi: int, active_increments: int,
                  wd: int, leak: bool, penalize: bool) -> tuple:
    """(rewards, penalties) as lists of Python integers (the spec's
    unbounded arithmetic)."""
    rewards, penalties = [], []
    for inc, m, e in zip(increments.tolist(), in_mask.tolist(), eligible.tolist()):
        base = inc * brpi
        rewards.append(base * weight * upi // (active_increments * wd) if m and e and not leak else 0)
        penalties.append(base * weight // wd if e and not m and penalize else 0)
    return rewards, penalties
