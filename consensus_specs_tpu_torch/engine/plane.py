"""StatePlane: the structure-of-arrays mirror of BeaconState's
registry-axis fields.

The spec stores the validator registry as an array-of-structures
(``List[Validator, ...]`` of 8-field containers) because that is what the
SSZ Merkleization contract demands. Epoch processing, however, is
registry-axis math: every hot sub-transition (rewards, inactivity,
effective-balance hysteresis, registry churn, slashings) reads a few
columns across ALL validators and writes a few columns back — exactly
the access pattern a training stack vectorizes by transposing
per-example structs into per-field arrays. ``StatePlane`` is that
transpose: one NumPy array per registry column, extracted in one pass
and written back sparsely (only changed rows), so the SSZ backing's
dirty-tracked incremental re-root still sees a minimal diff.

Exactness contract: every integer op in the vectorized stages must be
bit-identical to the spec's unbounded-int arithmetic. uint64 columns
make that nontrivial — NumPy wraps silently on multiply overflow — so
the guarded helpers below prove (with Python-int bounds checks) that a
product fits 64 bits before taking the array fast path, and fall back
to exact object-int rows otherwise. The crosscheck harness
(engine/crosscheck.py) enforces the contract against the interpreted
oracle on randomized states.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

U64_MAX = 2**64 - 1


def u64(seq, n: int) -> np.ndarray:
    """One registry column as uint64 (FAR_FUTURE_EPOCH == 2**64-1 fits)."""
    return np.fromiter((int(v) for v in seq), dtype=np.uint64, count=n)


def mul_floordiv(a: np.ndarray, mul: int, div: int) -> np.ndarray:
    """Exact elementwise ``a * mul // div`` for a uint64 column.

    Fast path only when the extreme row provably fits 64 bits; otherwise
    every row goes through Python ints (exact, slow, rare)."""
    mul, div = int(mul), int(div)
    if a.size == 0:
        return a.copy()
    if mul == 0:
        return np.zeros_like(a)
    if int(a.max()) * mul <= U64_MAX:
        return (a * np.uint64(mul)) // np.uint64(div)
    return np.fromiter(
        (int(x) * mul // div for x in a.tolist()), dtype=np.uint64, count=a.size
    )


def pairwise_mul_floordiv(a: np.ndarray, b: np.ndarray, div: int) -> np.ndarray:
    """Exact elementwise ``a * b // div`` for two uint64 columns (the
    effective-balance x inactivity-score product, whose second factor is
    unbounded in adversarial states)."""
    div = int(div)
    if a.size == 0:
        return a.copy()
    if int(a.max()) * int(b.max()) <= U64_MAX:
        return (a * b) // np.uint64(div)
    return np.fromiter(
        (int(x) * int(y) // div for x, y in zip(a.tolist(), b.tolist())),
        dtype=np.uint64,
        count=a.size,
    )


def apply_deltas(balances: np.ndarray, rewards: np.ndarray, penalties: np.ndarray) -> np.ndarray:
    """One increase_balance/decrease_balance sweep: add rewards, then
    floor-at-zero subtract penalties (beacon-chain.md:1100-1117 order)."""
    b = balances + rewards
    return np.where(penalties > b, np.uint64(0), b - penalties)


class StatePlane:
    """Registry-axis columns of one BeaconState, plus sparse write-back.

    Columns are NumPy uint64/uint8/bool; altair-family columns are None
    on phase0 states. ``writeback_*`` methods push only rows that differ
    from the extraction snapshot, preserving the SSZ dirty-tracking
    economy of the interpreted path.
    """

    __slots__ = (
        "n",
        "balances",
        "effective_balance",
        "slashed",
        "activation_eligibility_epoch",
        "activation_epoch",
        "exit_epoch",
        "withdrawable_epoch",
        "previous_participation",
        "current_participation",
        "inactivity_scores",
        "fully_withdrawn_epoch",
    )

    def __init__(self, state) -> None:
        vals = list(state.validators)
        n = self.n = len(vals)
        self.balances = u64(state.balances, n)
        self.effective_balance = u64((v.effective_balance for v in vals), n)
        self.slashed = np.fromiter((bool(v.slashed) for v in vals), dtype=bool, count=n)
        self.activation_eligibility_epoch = u64(
            (v.activation_eligibility_epoch for v in vals), n
        )
        self.activation_epoch = u64((v.activation_epoch for v in vals), n)
        self.exit_epoch = u64((v.exit_epoch for v in vals), n)
        self.withdrawable_epoch = u64((v.withdrawable_epoch for v in vals), n)
        self.previous_participation: Optional[np.ndarray] = None
        self.current_participation: Optional[np.ndarray] = None
        self.inactivity_scores: Optional[np.ndarray] = None
        self.fully_withdrawn_epoch: Optional[np.ndarray] = None
        if vals and hasattr(vals[0], "fully_withdrawn_epoch"):  # capella family
            self.fully_withdrawn_epoch = u64(
                (v.fully_withdrawn_epoch for v in vals), n
            )
        if hasattr(state, "previous_epoch_participation"):
            self.previous_participation = np.fromiter(
                state.previous_epoch_participation, dtype=np.uint8, count=n
            )
            self.current_participation = np.fromiter(
                state.current_epoch_participation, dtype=np.uint8, count=n
            )
            self.inactivity_scores = u64(state.inactivity_scores, n)

    # -- masks ---------------------------------------------------------------

    def active_mask(self, epoch: int) -> np.ndarray:
        """is_active_validator per row (beacon-chain.md:630)."""
        e = np.uint64(int(epoch))
        return (self.activation_epoch <= e) & (e < self.exit_epoch)

    def eligible_mask(self, previous_epoch: int) -> np.ndarray:
        """get_eligible_validator_indices per row (beacon-chain.md:1430)."""
        pe = int(previous_epoch)
        return self.active_mask(pe) | (
            self.slashed & (np.uint64(pe + 1) < self.withdrawable_epoch)
        )

    def total_balance(self, mask: np.ndarray, increment: int) -> int:
        """get_total_balance over a row mask (max(increment, sum))."""
        return max(int(increment), int(self.effective_balance[mask].sum(dtype=object)))

    def total_active_balance(self, current_epoch: int, increment: int) -> int:
        return self.total_balance(self.active_mask(current_epoch), increment)

    def participation_mask(self, flag_index: int, epoch: int, previous_epoch: int) -> np.ndarray:
        """get_unslashed_participating_indices as a row mask: active at
        ``epoch``, flag set in that epoch's participation, not slashed."""
        part = (
            self.current_participation
            if epoch != previous_epoch
            else self.previous_participation
        )
        flag = np.uint8(1 << int(flag_index))
        return self.active_mask(epoch) & ((part & flag) != 0) & ~self.slashed

    # -- sparse write-back ---------------------------------------------------

    def writeback_balances(self, state, new: np.ndarray) -> None:
        for i in np.nonzero(new != self.balances)[0]:
            state.balances[int(i)] = int(new[i])
        self.balances = new

    def writeback_inactivity_scores(self, state, new: np.ndarray) -> None:
        for i in np.nonzero(new != self.inactivity_scores)[0]:
            state.inactivity_scores[int(i)] = int(new[i])
        self.inactivity_scores = new

    def writeback_validator_column(self, state, field: str, new: np.ndarray) -> None:
        old = getattr(self, field)
        for i in np.nonzero(new != old)[0]:
            setattr(state.validators[int(i)], _FIELD_NAMES[field], int(new[i]))
        setattr(self, field, new)


# plane column -> Validator container field
_FIELD_NAMES = {
    "effective_balance": "effective_balance",
    "activation_eligibility_epoch": "activation_eligibility_epoch",
    "activation_epoch": "activation_epoch",
    "exit_epoch": "exit_epoch",
    "withdrawable_epoch": "withdrawable_epoch",
    "fully_withdrawn_epoch": "fully_withdrawn_epoch",  # capella family
}
