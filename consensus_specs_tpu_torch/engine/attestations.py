"""Vectorized pending-attestation resolution (phase0 family).

Phase0 epoch accounting keys everything on *who attested*: committee
membership per (slot, index) sliced out of the swap-or-not permutation,
intersected with each attestation's aggregation bits. The interpreted
path materializes Python sets per attestation per component (source,
target, head, inclusion — four passes); here each attestation's member
rows are gathered ONCE as a NumPy index array from the cached shuffle
permutation, and every component reduces those arrays with boolean
scatters. Bit-identical by construction: the permutation is the spec's
own cached ``_shuffle_permutation``, the slicing mirrors
compute_committee's integer bounds exactly.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


class EpochCommittees:
    """Committee geometry of one epoch, in array form."""

    def __init__(self, spec, state, epoch: int) -> None:
        self.epoch = int(epoch)
        self.active = np.asarray(
            [int(i) for i in spec.get_active_validator_indices(state, epoch)],
            dtype=np.int64,
        )
        seed = spec.get_seed(state, epoch, spec.DOMAIN_BEACON_ATTESTER)
        self.perm = spec._shuffle_permutation(len(self.active), seed)
        self.committees_per_slot = int(spec.get_committee_count_per_slot(state, epoch))
        self.slots_per_epoch = int(spec.SLOTS_PER_EPOCH)
        self.count = self.committees_per_slot * self.slots_per_epoch

    def committee(self, slot: int, index: int) -> np.ndarray:
        """compute_committee's slice of the shuffled active set
        (beacon-chain.md:807) as validator-index rows."""
        i = (int(slot) % self.slots_per_epoch) * self.committees_per_slot + int(index)
        n = len(self.active)
        start = n * i // self.count
        end = n * (i + 1) // self.count
        assert end <= n  # the spec's per-element bound assert, batched
        return self.active[self.perm[start:end]]


def resolve_members(spec, state, attestations: Sequence,
                    cache: Dict[int, EpochCommittees]) -> List[Tuple[object, np.ndarray]]:
    """[(attestation, attesting validator rows)] — get_attesting_indices
    for every attestation in one pass, committees cached per epoch."""
    out = []
    for a in attestations:
        epoch = int(spec.compute_epoch_at_slot(a.data.slot))
        comm = cache.get(epoch)
        if comm is None:
            comm = cache[epoch] = EpochCommittees(spec, state, epoch)
        members = comm.committee(int(a.data.slot), int(a.data.index))
        bits = np.fromiter(a.aggregation_bits, dtype=bool, count=len(a.aggregation_bits))
        assert len(bits) == len(members)  # process_attestation's length contract
        out.append((a, members[bits]))
    return out


def attester_mask(n: int, resolved: Sequence[Tuple[object, np.ndarray]],
                  slashed: np.ndarray) -> np.ndarray:
    """get_unslashed_attesting_indices as a row mask: the union of all
    attesting rows, minus slashed."""
    mask = np.zeros(n, dtype=bool)
    for _, members in resolved:
        mask[members] = True
    return mask & ~slashed


# ---------------------------------------------------------------------------
# Batched block-path process_attestation (all four production forks)
# ---------------------------------------------------------------------------

def _assert_valid_indexed(spec, state, attestation, attesting: np.ndarray) -> None:
    """The spec's `assert is_valid_indexed_attestation(state,
    get_indexed_attestation(state, attestation))` with the committee
    gather reused: attesting rows are unique permutation slots, so
    sorted(rows) IS sorted(set(...)) and the container build + signature
    adjudication are the spec's own."""
    indexed = spec.IndexedAttestation(
        attesting_indices=sorted(int(i) for i in attesting),
        data=attestation.data,
        signature=attestation.signature,
    )
    assert spec.is_valid_indexed_attestation(state, indexed)


def _writeback_participation(column, new: np.ndarray, old: np.ndarray) -> None:
    for i in np.nonzero(new != old)[0]:
        column[int(i)] = int(new[i])


def process_attestations_batch(spec, state, attestations) -> None:
    """Sequentially-exact batch of the spec's per-attestation
    ``process_attestation`` loop (the block body's attestation sweep).

    Semantics contract: bit-identical to
    ``for a in attestations: spec.process_attestation(state, a)`` —
    including the assert ORDER on invalid input and the partial state
    mutation an invalid attestation leaves behind (earlier valid
    attestations stay applied; the block-level caller discards the
    state, but the differential tests hold the batch to the oracle's
    exact wreckage). What is batched:

    - committee resolution: one :class:`EpochCommittees` per target
      epoch (one shuffle-permutation slice table) instead of a
      ``get_beacon_committee`` walk per attestation;
    - altair-family participation flags: both epoch columns are
      mirrored as uint8 arrays once, each attestation's newly-set flags
      are a vector compare + scatter over its member rows, and the
      proposer-reward numerator is a vector gather-sum of the
      precomputed base-reward column (constant across the batch — no
      operation between attestations changes effective balances);
    - per-block invariants (proposer index, base reward per increment)
      resolved once instead of per attestation.

    The phase0 family appends PendingAttestations (cheap) but still
    wins the committee cache and the single proposer resolution.
    """
    atts = list(attestations)
    if not atts:
        return
    n = len(state.validators)
    prev_ep = spec.get_previous_epoch(state)
    cur_ep = spec.get_current_epoch(state)
    cache: Dict[int, EpochCommittees] = {}
    proposer = None  # resolved once, lazily (constant while state.slot is fixed)
    post_altair = hasattr(state, "current_epoch_participation")
    if post_altair:
        cur_col = np.fromiter(state.current_epoch_participation, dtype=np.uint8, count=n)
        prev_col = np.fromiter(state.previous_epoch_participation, dtype=np.uint8, count=n)
        cur_snap, prev_snap = cur_col.copy(), prev_col.copy()
        incr = np.uint64(int(spec.EFFECTIVE_BALANCE_INCREMENT))
        brpi = np.uint64(int(spec.get_base_reward_per_increment(state)))
        base_reward = (
            np.fromiter((int(v.effective_balance) for v in state.validators),
                        dtype=np.uint64, count=n) // incr
        ) * brpi
        weights = [int(w) for w in spec.PARTICIPATION_FLAG_WEIGHTS]
        wd, pw = int(spec.WEIGHT_DENOMINATOR), int(spec.PROPOSER_WEIGHT)
        proposer_reward_denominator = (wd - pw) * wd // pw
    try:
        for a in atts:
            data = a.data
            # the spec's rejection ladder, verbatim order
            assert data.target.epoch in (prev_ep, cur_ep)
            assert data.target.epoch == spec.compute_epoch_at_slot(data.slot)
            assert (data.slot + spec.MIN_ATTESTATION_INCLUSION_DELAY
                    <= state.slot <= data.slot + spec.SLOTS_PER_EPOCH)
            assert data.index < spec.get_committee_count_per_slot(state, data.target.epoch)

            epoch = int(data.target.epoch)
            comm = cache.get(epoch)
            if comm is None:
                comm = cache[epoch] = EpochCommittees(spec, state, epoch)
            members = comm.committee(int(data.slot), int(data.index))
            assert len(a.aggregation_bits) == len(members)
            bits = np.fromiter(a.aggregation_bits, dtype=bool, count=len(members))
            attesting = members[bits]
            if proposer is None:
                proposer = spec.ValidatorIndex(int(spec.get_beacon_proposer_index(state)))

            if not post_altair:
                pending = spec.PendingAttestation(
                    data=data,
                    aggregation_bits=a.aggregation_bits,
                    inclusion_delay=state.slot - data.slot,
                    proposer_index=proposer,
                )
                if data.target.epoch == cur_ep:
                    assert data.source == state.current_justified_checkpoint
                    state.current_epoch_attestations.append(pending)
                else:
                    assert data.source == state.previous_justified_checkpoint
                    state.previous_epoch_attestations.append(pending)
                # signature last (cheapest rejections first), like the spec
                _assert_valid_indexed(spec, state, a, attesting)
                continue

            # altair family: flag indices raise on source mismatch (the
            # spec's assert is inside get_attestation_participation_flag_indices)
            flag_indices = spec.get_attestation_participation_flag_indices(
                state, data, state.slot - data.slot
            )
            _assert_valid_indexed(spec, state, a, attesting)
            col = cur_col if data.target.epoch == cur_ep else prev_col
            numerator = 0
            for flag_index in flag_indices:
                flag = np.uint8(1 << int(flag_index))
                fresh = attesting[(col[attesting] & flag) == 0]
                if fresh.size:
                    col[fresh] |= flag
                    numerator += int(base_reward[fresh].sum(dtype=object)) * weights[int(flag_index)]
            reward = spec.Gwei(numerator // proposer_reward_denominator)
            spec.increase_balance(state, proposer, reward)
    finally:
        # the mirrors land in the SSZ columns on EVERY exit path, so a
        # mid-batch rejection leaves exactly the oracle's partial state
        if post_altair:
            _writeback_participation(state.current_epoch_participation, cur_col, cur_snap)
            _writeback_participation(state.previous_epoch_participation, prev_col, prev_snap)
