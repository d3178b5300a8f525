"""Vectorized epoch-processing stages — batched gathers/scatters/
segment-sums over the StatePlane, bit-identical to the interpreted spec.

Each ``vectorized_process_*`` takes ``(spec, state)`` and mutates the
state exactly like the spec module's ``process_*`` of the same name.
Fork families are dispatched on ``spec.fork``: phase0 accounts rewards
from pending attestations (committee resolution via the cached shuffle
permutation), altair and later from participation flags; the
fork-specific quotients (PROPORTIONAL_SLASHING_MULTIPLIER*,
INACTIVITY_PENALTY_QUOTIENT*) are resolved the way the fork-delta
compiler resolved them into each flat module.

Every formula keeps the spec's operation ORDER (sequential floordivs,
per-pair increase-then-floored-decrease balance application) — integer
floordiv does not commute, and the crosscheck harness holds these
implementations to hash_tree_root equality with the interpreted oracle.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np

from . import backend
from .attestations import EpochCommittees, attester_mask, resolve_members
from .plane import (
    U64_MAX,
    StatePlane,
    apply_deltas,
    mul_floordiv,
    pairwise_mul_floordiv,
)


def _epochs(spec, state) -> Tuple[int, int]:
    return int(spec.get_previous_epoch(state)), int(spec.get_current_epoch(state))


def _finality_delay(spec, state, prev: int) -> int:
    return prev - int(state.finalized_checkpoint.epoch)


def _is_leak(spec, state, prev: int) -> bool:
    return _finality_delay(spec, state, prev) > int(spec.MIN_EPOCHS_TO_INACTIVITY_PENALTY)


# Fork-delta quotient resolution: the flat spec modules carry the
# suffixed constant their own fork resolved (altair re-tuned both
# quotients, bellatrix re-tuned them again, capella kept bellatrix's) —
# dispatch must name every production fork explicitly so a new fork
# can't silently inherit the wrong penalty family.
_BELLATRIX_FAMILY = ("bellatrix", "capella")


def _inactivity_quotient(spec) -> int:
    if spec.fork == "altair":
        return int(spec.INACTIVITY_PENALTY_QUOTIENT_ALTAIR)
    if spec.fork in _BELLATRIX_FAMILY:
        return int(spec.INACTIVITY_PENALTY_QUOTIENT_BELLATRIX)
    raise ValueError(f"no inactivity-quotient family for fork {spec.fork!r}")


def _slashings_multiplier(spec) -> int:
    if spec.fork == "phase0":
        return int(spec.PROPORTIONAL_SLASHING_MULTIPLIER)
    if spec.fork == "altair":
        return int(spec.PROPORTIONAL_SLASHING_MULTIPLIER_ALTAIR)
    if spec.fork in _BELLATRIX_FAMILY:
        return int(spec.PROPORTIONAL_SLASHING_MULTIPLIER_BELLATRIX)
    raise ValueError(f"no slashing-multiplier family for fork {spec.fork!r}")


# ---------------------------------------------------------------------------
# Justification & finalization
# ---------------------------------------------------------------------------

def vectorized_process_justification_and_finalization(spec, state) -> None:
    prev, cur = _epochs(spec, state)
    if cur <= int(spec.GENESIS_EPOCH) + 1:
        return
    plane = StatePlane(state)
    incr = int(spec.EFFECTIVE_BALANCE_INCREMENT)
    tab = plane.total_active_balance(cur, incr)
    if spec.fork == "phase0":
        cache: Dict[int, EpochCommittees] = {}
        prev_resolved = resolve_members(
            spec, state, spec.get_matching_target_attestations(state, spec.Epoch(prev)), cache
        )
        cur_resolved = resolve_members(
            spec, state, spec.get_matching_target_attestations(state, spec.Epoch(cur)), cache
        )
        prev_bal = plane.total_balance(
            attester_mask(plane.n, prev_resolved, plane.slashed), incr
        )
        cur_bal = plane.total_balance(
            attester_mask(plane.n, cur_resolved, plane.slashed), incr
        )
    else:
        tt = int(spec.TIMELY_TARGET_FLAG_INDEX)
        prev_bal = plane.total_balance(plane.participation_mask(tt, prev, prev), incr)
        cur_bal = plane.total_balance(plane.participation_mask(tt, cur, prev), incr)
    # the FFG checkpoint/bitvector update is O(1): delegate to the spec
    spec.weigh_justification_and_finalization(
        state, spec.Gwei(tab), spec.Gwei(prev_bal), spec.Gwei(cur_bal)
    )


# ---------------------------------------------------------------------------
# Rewards & penalties — phase0 family (pending-attestation components)
# ---------------------------------------------------------------------------

class _Phase0Ctx:
    """Shared reward-accounting inputs: one committee resolution, one
    base-reward column, reused by all four component passes."""

    def __init__(self, spec, state, plane: StatePlane) -> None:
        self.spec, self.plane = spec, plane
        self.prev, self.cur = _epochs(spec, state)
        self.incr = int(spec.EFFECTIVE_BALANCE_INCREMENT)
        self.tab = plane.total_active_balance(self.cur, self.incr)
        sqrt_total = math.isqrt(self.tab)
        self.finality_delay = _finality_delay(spec, state, self.prev)
        self.leak = self.finality_delay > int(spec.MIN_EPOCHS_TO_INACTIVITY_PENALTY)
        self.eligible = plane.eligible_mask(self.prev)
        base = mul_floordiv(plane.effective_balance, int(spec.BASE_REWARD_FACTOR), sqrt_total)
        self.base = base // np.uint64(int(spec.BASE_REWARDS_PER_EPOCH))

        cache: Dict[int, EpochCommittees] = {}
        prev_e = spec.Epoch(self.prev)
        self.src = resolve_members(
            spec, state, spec.get_matching_source_attestations(state, prev_e), cache
        )
        by_id = {id(a): m for a, m in self.src}
        self.tgt = [
            (a, by_id[id(a)]) for a in spec.get_matching_target_attestations(state, prev_e)
        ]
        self.head = [
            (a, by_id[id(a)]) for a in spec.get_matching_head_attestations(state, prev_e)
        ]


def _component_deltas(ctx: _Phase0Ctx, resolved: Sequence) -> Tuple[np.ndarray, np.ndarray]:
    """get_attestation_component_deltas over one attestation set."""
    plane, n = ctx.plane, ctx.plane.n
    unslashed = attester_mask(n, resolved, plane.slashed)
    att_bal = plane.total_balance(unslashed, ctx.incr)
    rewards = np.zeros(n, dtype=np.uint64)
    penalties = np.zeros(n, dtype=np.uint64)
    rmask = ctx.eligible & unslashed
    if ctx.leak:
        rewards[rmask] = ctx.base[rmask]
    else:
        rewards[rmask] = mul_floordiv(
            ctx.base[rmask], att_bal // ctx.incr, ctx.tab // ctx.incr
        )
    pmask = ctx.eligible & ~unslashed
    penalties[pmask] = ctx.base[pmask]
    return rewards, penalties


def _inclusion_delay_rewards(ctx: _Phase0Ctx) -> np.ndarray:
    """get_inclusion_delay_deltas: stable sweep by inclusion delay,
    earliest attestation wins each index (beacon-chain.md:1496)."""
    spec, plane, n = ctx.spec, ctx.plane, ctx.plane.n
    rewards = np.zeros(n, dtype=np.uint64)
    prq = np.uint64(int(spec.PROPOSER_REWARD_QUOTIENT))
    unslashed_src = attester_mask(n, ctx.src, plane.slashed)
    assigned = np.zeros(n, dtype=bool)
    for a, members in sorted(ctx.src, key=lambda t: int(t[0].inclusion_delay)):
        if members.size == 0:
            continue
        sel = members[unslashed_src[members] & ~assigned[members]]
        if sel.size == 0:
            continue
        assigned[sel] = True
        base_sel = ctx.base[sel]
        proposer_cut = base_sel // prq
        rewards[int(a.proposer_index)] += proposer_cut.sum(dtype=np.uint64)
        rewards[sel] += (base_sel - proposer_cut) // np.uint64(int(a.inclusion_delay))
    return rewards


def _phase0_inactivity_penalties(ctx: _Phase0Ctx) -> np.ndarray:
    """get_inactivity_penalty_deltas (quadratic leak, phase0 form)."""
    spec, plane, n = ctx.spec, ctx.plane, ctx.plane.n
    penalties = np.zeros(n, dtype=np.uint64)
    if ctx.leak:
        target_unslashed = attester_mask(n, ctx.tgt, plane.slashed)
        brpe = np.uint64(int(spec.BASE_REWARDS_PER_EPOCH))
        prq = np.uint64(int(spec.PROPOSER_REWARD_QUOTIENT))
        flat = brpe * ctx.base - ctx.base // prq
        penalties[ctx.eligible] += flat[ctx.eligible]
        extra = ctx.eligible & ~target_unslashed
        penalties[extra] += mul_floordiv(
            plane.effective_balance[extra],
            ctx.finality_delay,
            int(spec.INACTIVITY_PENALTY_QUOTIENT),
        )
    return penalties


def _phase0_rewards_and_penalties(spec, state, plane: StatePlane) -> None:
    ctx = _Phase0Ctx(spec, state, plane)
    r_src, p_src = _component_deltas(ctx, ctx.src)
    r_tgt, p_tgt = _component_deltas(ctx, ctx.tgt)
    r_head, p_head = _component_deltas(ctx, ctx.head)
    rewards = r_src + r_tgt + r_head + _inclusion_delay_rewards(ctx)
    penalties = p_src + p_tgt + p_head + _phase0_inactivity_penalties(ctx)
    plane.writeback_balances(state, apply_deltas(plane.balances, rewards, penalties))


# ---------------------------------------------------------------------------
# Rewards & penalties — altair family (flag weights + inactivity scores)
# ---------------------------------------------------------------------------

def _flag_deltas(increments: np.ndarray, in_mask: np.ndarray, eligible: np.ndarray,
                 brpi: int, weight: int, upi: int, active_increments: int,
                 wd: int, leak: bool, penalize: bool) -> Tuple[np.ndarray, np.ndarray]:
    """get_flag_index_deltas arithmetic for one flag. Goes to the torch
    backend's kernel only when that backend is on, the registry is large
    enough to amortize the dispatch, AND the host-side bound proves the
    reward numerator lies in the kernel's exact range (uint64 for K10 on
    the card, int64 for its plain version on the CPU). Otherwise the exact
    numpy path below computes it; that is the stage's own semantics, not a
    fallback: a failed launch raises."""
    n = increments.size
    hi = int(increments.max()) if n else 0
    kernel = backend.delta_kernel()
    if (kernel is not None and n >= backend.DEVICE_MIN_ROWS
            and hi * brpi * weight * max(upi, 1) <= backend.exact_max()):
        return kernel(increments, in_mask, eligible, brpi, weight, upi,
                      active_increments, wd, leak, penalize)
    rewards = np.zeros(n, dtype=np.uint64)
    penalties = np.zeros(n, dtype=np.uint64)
    base = mul_floordiv(increments, brpi, 1)
    rmask = in_mask & eligible
    if not leak:
        rewards[rmask] = mul_floordiv(base[rmask], weight * upi, active_increments * wd)
    if penalize:
        pmask = eligible & ~in_mask
        penalties[pmask] = mul_floordiv(base[pmask], weight, wd)
    return rewards, penalties


def _altair_inactivity_deltas(spec, plane: StatePlane, eligible: np.ndarray,
                              prev: int) -> Tuple[np.ndarray, np.ndarray]:
    n = plane.n
    rewards = np.zeros(n, dtype=np.uint64)
    penalties = np.zeros(n, dtype=np.uint64)
    tt = int(spec.TIMELY_TARGET_FLAG_INDEX)
    matching_target = plane.participation_mask(tt, prev, prev)
    pmask = eligible & ~matching_target
    denominator = int(spec.config.INACTIVITY_SCORE_BIAS) * _inactivity_quotient(spec)
    penalties[pmask] = pairwise_mul_floordiv(
        plane.effective_balance[pmask], plane.inactivity_scores[pmask], denominator
    )
    return rewards, penalties


def _altair_rewards_and_penalties(spec, state, plane: StatePlane) -> None:
    prev, cur = _epochs(spec, state)
    incr = int(spec.EFFECTIVE_BALANCE_INCREMENT)
    tab = plane.total_active_balance(cur, incr)
    brpi = incr * int(spec.BASE_REWARD_FACTOR) // math.isqrt(tab)
    leak = _is_leak(spec, state, prev)
    eligible = plane.eligible_mask(prev)
    increments = plane.effective_balance // np.uint64(incr)
    active_increments = tab // incr
    wd = int(spec.WEIGHT_DENOMINATOR)
    head = int(spec.TIMELY_HEAD_FLAG_INDEX)

    deltas: List[Tuple[np.ndarray, np.ndarray]] = []
    for flag_index, weight in enumerate(spec.PARTICIPATION_FLAG_WEIGHTS):
        in_mask = plane.participation_mask(flag_index, prev, prev)
        upi = plane.total_balance(in_mask, incr) // incr
        deltas.append(
            _flag_deltas(increments, in_mask, eligible, brpi, int(weight), upi,
                         active_increments, wd, leak, flag_index != head)
        )
    deltas.append(_altair_inactivity_deltas(spec, plane, eligible, prev))

    balances = plane.balances
    for rewards, penalties in deltas:  # the spec applies pair by pair
        balances = apply_deltas(balances, rewards, penalties)
    plane.writeback_balances(state, balances)


def vectorized_process_rewards_and_penalties(spec, state) -> None:
    if int(spec.get_current_epoch(state)) == int(spec.GENESIS_EPOCH):
        return
    plane = StatePlane(state)
    if spec.fork == "phase0":
        _phase0_rewards_and_penalties(spec, state, plane)
    else:
        _altair_rewards_and_penalties(spec, state, plane)


# ---------------------------------------------------------------------------
# Inactivity-score updates (altair+)
# ---------------------------------------------------------------------------

def vectorized_process_inactivity_updates(spec, state) -> None:
    prev, cur = _epochs(spec, state)
    if cur == int(spec.GENESIS_EPOCH):
        return
    plane = StatePlane(state)
    tt = int(spec.TIMELY_TARGET_FLAG_INDEX)
    participating = plane.participation_mask(tt, prev, prev)
    eligible = plane.eligible_mask(prev)
    scores = plane.inactivity_scores.copy()

    dec = eligible & participating
    scores[dec] -= np.minimum(np.uint64(1), scores[dec])
    inc = eligible & ~participating
    scores[inc] += np.uint64(int(spec.config.INACTIVITY_SCORE_BIAS))
    if not _is_leak(spec, state, prev):
        recovery = np.uint64(int(spec.config.INACTIVITY_SCORE_RECOVERY_RATE))
        scores[eligible] -= np.minimum(recovery, scores[eligible])
    plane.writeback_inactivity_scores(state, scores)


# ---------------------------------------------------------------------------
# Effective-balance hysteresis
# ---------------------------------------------------------------------------

def vectorized_process_effective_balance_updates(spec, state) -> None:
    plane = StatePlane(state)
    incr = np.uint64(int(spec.EFFECTIVE_BALANCE_INCREMENT))
    hysteresis = np.uint64(
        int(spec.EFFECTIVE_BALANCE_INCREMENT) // int(spec.HYSTERESIS_QUOTIENT)
    )
    down = hysteresis * np.uint64(int(spec.HYSTERESIS_DOWNWARD_MULTIPLIER))
    up = hysteresis * np.uint64(int(spec.HYSTERESIS_UPWARD_MULTIPLIER))
    balances, eff = plane.balances, plane.effective_balance
    needs_update = (balances + down < eff) | (eff + up < balances)
    trimmed = np.minimum(
        balances - balances % incr, np.uint64(int(spec.MAX_EFFECTIVE_BALANCE))
    )
    plane.writeback_validator_column(
        state, "effective_balance", np.where(needs_update, trimmed, eff)
    )


# ---------------------------------------------------------------------------
# Registry updates (eligibility, ejections, activation churn)
# ---------------------------------------------------------------------------

def vectorized_process_registry_updates(spec, state) -> None:
    plane = StatePlane(state)
    cur = int(spec.get_current_epoch(state))
    far = np.uint64(U64_MAX)

    # Activation-queue eligibility
    queue_eligible = (plane.activation_eligibility_epoch == far) & (
        plane.effective_balance == np.uint64(int(spec.MAX_EFFECTIVE_BALANCE))
    )
    new_eligibility = np.where(
        queue_eligible, np.uint64(cur + 1), plane.activation_eligibility_epoch
    )

    # Ejections: initiate_validator_exit's queue is sequential state —
    # simulate (queue epoch, churn-at-epoch) scalars over the masked rows
    # in index order; everything else stays vectorized.
    active_cur = plane.active_mask(cur)
    eject_rows = np.nonzero(
        active_cur & (plane.effective_balance <= np.uint64(int(spec.config.EJECTION_BALANCE)))
    )[0]
    new_exit = plane.exit_epoch.copy()
    new_withdrawable = plane.withdrawable_epoch.copy()
    churn_limit = max(
        int(spec.config.MIN_PER_EPOCH_CHURN_LIMIT),
        int(active_cur.sum()) // int(spec.config.CHURN_LIMIT_QUOTIENT),
    )
    activation_exit_epoch = cur + 1 + int(spec.MAX_SEED_LOOKAHEAD)
    known_exits = new_exit[new_exit != far]
    queue_epoch = max(
        int(known_exits.max()) if known_exits.size else 0, activation_exit_epoch
    )
    churn = int((new_exit == np.uint64(queue_epoch)).sum())
    withdrawability_delay = int(spec.config.MIN_VALIDATOR_WITHDRAWABILITY_DELAY)
    for i in eject_rows:
        if new_exit[i] != far:
            continue
        if churn >= churn_limit:
            queue_epoch += 1
            churn = 0
        withdrawable_at = queue_epoch + withdrawability_delay
        if queue_epoch > U64_MAX or withdrawable_at > U64_MAX:
            # the spec surfaces this as Epoch()'s uint64 bound check
            raise ValueError(f"Epoch out of range: {withdrawable_at}")
        new_exit[i] = queue_epoch
        new_withdrawable[i] = withdrawable_at
        churn += 1

    # Dequeue activations up to the churn limit, (eligibility epoch, index)
    # order — stable argsort on the epoch column IS that order.
    finalized = np.uint64(int(state.finalized_checkpoint.epoch))
    candidates = np.nonzero((new_eligibility <= finalized) & (plane.activation_epoch == far))[0]
    order = candidates[np.argsort(new_eligibility[candidates], kind="stable")]
    new_activation = plane.activation_epoch.copy()
    new_activation[order[:churn_limit]] = np.uint64(activation_exit_epoch)

    plane.writeback_validator_column(state, "activation_eligibility_epoch", new_eligibility)
    plane.writeback_validator_column(state, "exit_epoch", new_exit)
    plane.writeback_validator_column(state, "withdrawable_epoch", new_withdrawable)
    plane.writeback_validator_column(state, "activation_epoch", new_activation)


# ---------------------------------------------------------------------------
# Slashings
# ---------------------------------------------------------------------------

def vectorized_process_slashings(spec, state) -> None:
    plane = StatePlane(state)
    cur = int(spec.get_current_epoch(state))
    incr = int(spec.EFFECTIVE_BALANCE_INCREMENT)
    total_balance = plane.total_active_balance(cur, incr)
    adjusted = min(
        sum(int(s) for s in state.slashings) * _slashings_multiplier(spec),
        total_balance,
    )
    target_epoch = cur + int(spec.EPOCHS_PER_SLASHINGS_VECTOR) // 2
    mask = plane.slashed & (plane.withdrawable_epoch == np.uint64(target_epoch))
    if not mask.any():
        return
    quotients = plane.effective_balance[mask] // np.uint64(incr)
    penalties = mul_floordiv(quotients, adjusted, total_balance) * np.uint64(incr)
    balances = plane.balances.copy()
    hit = balances[mask]
    balances[mask] = np.where(penalties > hit, np.uint64(0), hit - penalties)
    plane.writeback_balances(state, balances)


# ---------------------------------------------------------------------------
# Full withdrawals (capella family)
# ---------------------------------------------------------------------------

def vectorized_process_full_withdrawals(spec, state) -> None:
    """Capella's registry sweep: the fully-withdrawable mask (eth1
    credential prefix, withdrawable_epoch <= epoch < fully_withdrawn_epoch)
    is computed as one vector compare; only the hit rows take the spec's
    sequential withdraw_balance path (the withdrawals_queue append order
    and withdrawal_index increments are sequential state, exactly like
    the exit queue in registry updates)."""
    plane = StatePlane(state)
    cur = int(spec.get_current_epoch(state))
    prefix = bytes(spec.ETH1_ADDRESS_WITHDRAWAL_PREFIX)[:1]
    eth1_credentialed = np.fromiter(
        (bytes(v.withdrawal_credentials)[:1] == prefix for v in state.validators),
        dtype=bool,
        count=plane.n,
    )
    e = np.uint64(cur)
    mask = (
        eth1_credentialed
        & (plane.withdrawable_epoch <= e)
        & (e < plane.fully_withdrawn_epoch)
    )
    for i in np.nonzero(mask)[0]:  # index order == the spec's loop order
        idx = int(i)
        spec.withdraw_balance(state, spec.ValidatorIndex(idx), state.balances[idx])
        state.validators[idx].fully_withdrawn_epoch = cur
